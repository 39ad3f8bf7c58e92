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

The JAX package runs each step as one jitted program, cached per
configuration and bucket. Its factories keep their names here
(``make_step_fn``, ``make_compact_step_fn``, ``make_tail_step_fn``,
``make_candidates_fn``, ``make_active_count_fn``): on the card the three
step factories capture a whole step in a CUDA graph and replay it
(``GraphStep``), on the CPU they run the eager step. ``render`` goes through
them; ``render_step``, ``compact_step``, ``candidates`` and ``tail_step``
stay the eager steps. No step waits on the device: ``render`` reads the
count of active pixels once a step, as the JAX package's does.

``dist.sharding`` builds its ranks' steps from the same pieces: the
steps split where a collective comes between (``step_radiance`` and
``add_sample``, ``tail_radiance`` and ``scatter_sample``), and a gradient
graph step (``GradGraphStep``: a forward and a backward graph, the loss
eager between them) stands for the JAX package's jitted
``value_and_grad``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import os
import time
import weakref
from typing import Optional

import torch

from isaklm_raytracer_tpu_torch import telemetry
from isaklm_raytracer_tpu_torch.accel.kd_traverse import nearest_hit_kd
from isaklm_raytracer_tpu_torch.accel.wavefront import nearest_hit_wavefront
from isaklm_raytracer_tpu_torch.camera.camera import Camera, generate_rays
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.path_trace import trace_paths
from isaklm_raytracer_tpu_torch.kernels.intersect import (
    COUNTS,
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

    key_words: per-sample (k0, k1) from ``rng.sample_key_words``, or their
    (2,) int64 tensor on the scene's device (``rng.key_tensor``), which a
    CUDA graph takes as an input.
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
) -> GBuffer:
    """Progressive step over every pixel, masked by the adaptive gate
    (path_tracing.cuh:338-395): ``step_radiance``, then ``add_sample``.

    For a shard of the image (``dist.sharding``): ``pixel_ids`` are the
    global ids of the G-buffer's entries and ``valid`` masks its
    padding."""
    radiance, took = step_radiance(scene, camera, gbuffer, key_words, config, adaptive,
                                   trace_fn, pixel_ids, valid)
    return add_sample(gbuffer, radiance, took)


def step_radiance(scene: Scene, camera: Camera, gbuffer: GBuffer, key_words,
                  config: RenderConfig, adaptive: bool = True, trace_fn=None,
                  pixel_ids: Optional[torch.Tensor] = None,
                  valid: Optional[torch.Tensor] = None):
    """The first half of ``render_step``: (the (R, 3) radiance, zero where
    no sample is taken; the mask of the pixels that take one, or None for
    all)."""
    active = valid
    if adaptive:
        gate = needs_sample(gbuffer, config)
        active = gate if valid is None else gate & valid
    radiance = render_sample(scene, camera, key_words, config, active, trace_fn, pixel_ids)
    return radiance, active


def add_sample(gbuffer: GBuffer, radiance: torch.Tensor,
               took: Optional[torch.Tensor]) -> GBuffer:
    """The second half of ``render_step``: the radiance added to every
    pixel, a sample counted where ``took`` (None: everywhere)."""
    took = took if took is not None else torch.ones_like(gbuffer.count, dtype=torch.bool)
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


def scatter_sample(gb: GBuffer, ids, radiance, valid) -> GBuffer:
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
    their count as a 0-dim tensor (``jnp.nonzero(size=bucket,
    fill_value=0)`` and ``jnp.sum``): past ``bucket`` actives the ids are
    cut off, the count is not. A cumsum gives each active pixel its slot,
    and the inactive and cut-off pixels all go to one spill slot past the
    end; nothing waits on the device, so a CUDA graph can capture it."""
    slot = torch.cumsum(active, 0) - 1
    slot = torch.where(active & (slot < bucket), slot, bucket)
    ids = torch.zeros((bucket + 1,), dtype=torch.int32, device=active.device)
    ids.scatter_(0, slot, torch.arange(active.shape[0], dtype=torch.int32,
                                       device=active.device))
    return ids[:bucket], active.sum()


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
    return scatter_sample(gb, ids.long(), radiance, valid)


def candidates(gb: GBuffer, config: RenderConfig, bucket: int,
               valid: Optional[torch.Tensor] = None):
    """(bucket,) ascending ids of the unconverged pixels (among ``valid``
    ones), -1 padded, and their count (a 0-dim tensor). One O(num_pixels)
    scan, done once when entering tail mode."""
    active = needs_sample(gb, config)
    ids, n = _first_ids(active if valid is None else active & valid, bucket)
    ids = torch.where(torch.arange(bucket, device=ids.device) < n, ids, -1)
    return ids, n


def tail_step(
    scene: Scene, camera: Camera, gb: GBuffer, cand: torch.Tensor, key_words,
    config: RenderConfig, trace_fn=None, pixel_ids: Optional[torch.Tensor] = None,
):
    """O(bucket) adaptive step over a CANDIDATE id set: ``tail_radiance``,
    then its scatter-add.

    A pixel that leaves the active set accumulates nothing, so it can never
    re-activate: the tail loop re-tests needs_sample only on the candidates.
    Actives stay ascending and compact to the front. Returns
    (gbuffer', candidates', n_active), n_active a 0-dim tensor that the
    caller reads when it needs it (nothing here waits on the device).
    ``pixel_ids`` as in ``render_step``.
    """
    radiance, ids, valid, cand2, n = tail_radiance(scene, camera, gb, cand, key_words, config,
                                                   trace_fn, pixel_ids)
    return scatter_sample(gb, ids.long(), radiance, valid), cand2, n


def tail_radiance(
    scene: Scene, camera: Camera, gb: GBuffer, cand: torch.Tensor, key_words,
    config: RenderConfig, trace_fn=None, pixel_ids: Optional[torch.Tensor] = None,
):
    """The first half of ``tail_step``: (the (bucket, 3) radiance of the
    active candidates, compacted to the front; their G-buffer ids; the mask
    of the real lanes; candidates'; n_active)."""
    bucket = cand.shape[0]
    valid_c = cand >= 0
    safe = torch.clamp_min(cand, 0).long()
    sub = GBuffer(gb.frame[safe], gb.sq_luminance[safe], gb.count[safe])
    active = needs_sample(sub, config) & valid_c
    n = active.sum()
    order = torch.argsort((~active).to(torch.int8), stable=True)
    cand2 = torch.where(torch.arange(bucket, device=cand.device) < n, cand[order], -1)
    ids = torch.clamp_min(cand2, 0)
    valid = cand2 >= 0
    radiance = render_sample(
        scene, camera, key_words, config, active=valid, trace_fn=trace_fn,
        pixel_ids=ids if pixel_ids is None else pixel_ids[ids.long()],
    )
    return radiance, ids, valid, cand2, n


# --- the step factories ----------------------------------------------------


class GraphStep:
    """A step on the card replayed from a CUDA graph: the port's
    counterpart of the JAX package's jitted step.

    ``step(fn, inputs)`` runs ``fn(*inputs)``, tensors on the card in and a
    tuple of tensors out. The first call runs ``fn`` eagerly: the warm-up a
    capture needs (the kernels' libraries load, their attributes are set)
    and that step's real result. The second call copies its inputs into
    static buffers, captures ``fn`` on them into a ``torch.cuda.CUDAGraph``
    and replays it; every later call copies its inputs in and replays. A
    replay returns copies of the graph's outputs, which the caller owns (a
    later replay overwrites the graph's own; JAX donates the G-buffer, the
    port copies it). A capture that fails raises: nothing falls back to the
    eager step. The step keeps no reference to ``fn``, whose closure holds
    the scene.

    A wrapper adds to ``kernels.intersect.COUNTS`` where Python launches
    its kernel: at an eager call, and at the capture, which records the
    launch into the graph and runs nothing. A replay runs no wrapper and
    moves no count. ``launches`` holds the launches the capture recorded,
    ``replays`` the replays; over every step of the process,
    ``GraphStep.recorded`` totals the launches captures recorded and
    ``GraphStep.replayed`` the launches replays issued (``launches`` at each
    replay). So the kernels the card ran are ``COUNTS - recorded +
    replayed``: a profiler's kernel records can be held to that
    (``chip_smoke.py``). ``capture_s``, ``instantiate_s`` and ``pool_bytes``
    (the memory the graph's private pool reserved) record the capture;
    ``captures`` counts the captures of every step in the process. Under
    a profiler a call that replays records the ``telemetry`` span
    ``graph.replay``: copy-in, replay and the output copies."""

    captures = 0
    recorded = collections.Counter()
    replayed = collections.Counter()

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.calls = self.replays = 0
        self.graph = None
        self.static_in = self.static_out = None
        self.launches = {}
        self.capture_s = self.instantiate_s = self.pool_bytes = None

    @classmethod
    def reset_tallies(cls) -> None:
        cls.recorded.clear()
        cls.replayed.clear()

    def __call__(self, fn, inputs) -> tuple:
        self.calls += 1
        if self.calls == 1:
            return tuple(fn(*inputs))
        with telemetry.span("graph.replay"), torch.cuda.device(self.device):
            if self.graph is None:
                self._capture(fn, inputs)
            for static, x in zip(self.static_in, inputs):
                static.copy_(x, non_blocking=True)
            self.graph.replay()
            self.replays += 1
            GraphStep.replayed.update(self.launches)
            return tuple(out.clone() for out in self.static_out)

    def _capture(self, fn, inputs) -> None:
        self.static_in = [x.clone() for x in inputs]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _no_collection(self.device):
            before = COUNTS.snapshot()
            out, self.capture_s, self.pool_bytes = _record(
                graph, self.device, lambda: tuple(fn(*self.static_in)))
        self.instantiate_s = _instantiate(graph)
        self.launches = _launched_since(before)
        GraphStep.recorded.update(self.launches)
        self.static_out = out
        self.graph = graph
        GraphStep.captures += 1


@contextlib.contextmanager
def _no_collection(device):
    """The block (a capture) with the card idle and no garbage collection:
    torch.cuda.graph collects no garbage before a capture (unless the
    force_cudagraph_gc setting asks it to), and a collection inside one
    that destroys a dead cycle's CUDA graph (a dropped _Graphs: its weak
    references' callbacks hold it) invalidates the capture; so collect
    before it and none during it. The collector is back on afterwards,
    also when the block raises, unless it was off before."""
    torch.cuda.synchronize(device)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _record(graph, device, fn, **pool):
    """``fn()`` captured into ``graph`` (``pool``: the ``pool=`` of
    ``torch.cuda.graph``): (its outputs, the capture's seconds, the bytes
    the graph's pool reserved)."""
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, **pool):
        # torch.cuda.graph has emptied the allocator's cache by now
        reserved = torch.cuda.memory_reserved(device)
        out = fn()
    return out, time.perf_counter() - t0, torch.cuda.memory_reserved(device) - reserved


def _instantiate(graph) -> float:
    """Instantiates a graph captured with ``keep_graph=True`` (kept so that
    its seconds are measured apart from the capture's, PERF.md section 5);
    returns them."""
    t0 = time.perf_counter()
    graph.instantiate()
    return time.perf_counter() - t0


def _launched_since(before: dict) -> dict:
    """The wrappers' launches since ``COUNTS.snapshot()`` gave ``before``."""
    after = COUNTS.snapshot()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _zeros_for_unused(grads, leaves) -> list:
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]


def _head_grad(head, out: torch.Tensor):
    """(value, d(objective)/d(out)) of ``head(out) -> (value, objective)``,
    by autograd on a detached view of ``out``; the value detached."""
    with torch.enable_grad():
        r = out.detach().requires_grad_()
        value, objective = head(r)
        (g,) = torch.autograd.grad(objective, r)
    return value.detach(), g


def split_value_and_grad(fn, leaves, inputs, head):
    """(value, grads) of ``head`` after ``fn``, the chain rule split at
    ``fn``'s output as a gradient graph step splits it: ``out =
    fn(*leaves, *inputs)`` with autograd recording ``leaves`` (detached
    copies that require grad); ``(value, objective) = head(out)`` and
    d(objective)/d(out) by autograd on a detached view of ``out``; then
    the backward of ``fn`` from ``out`` with that gradient. ``grads`` are
    those of the objective with respect to ``leaves``, zeros for a leaf
    ``fn`` does not use. The ops are eager autograd's own: where ``head``
    uses ``out`` once, the grads equal those of ``objective`` taken
    through ``fn`` in one backward, bit for bit."""
    with torch.enable_grad():
        with telemetry.span("train.forward"):
            xs = [x.detach().requires_grad_() for x in leaves]
            out = fn(*xs, *inputs)
        with telemetry.span("train.loss"):
            value, g = _head_grad(head, out)
        with telemetry.span("train.backward"):
            grads = torch.autograd.grad(out, xs, g, allow_unused=True)
    return value, _zeros_for_unused(grads, xs)


class GradGraphStep(GraphStep):
    """A gradient step on the card replayed from two CUDA graphs, a
    forward and a backward captured into one memory pool (the pattern of
    ``torch.cuda.make_graphed_callables``): the port's counterpart of the
    JAX package's jitted ``value_and_grad``.

    ``step(fn, leaves, inputs, head)`` returns ``split_value_and_grad(fn,
    leaves, inputs, head)``: ``fn(*leaves, *inputs)`` a tensor, tensors on
    the card in. The first call runs it eagerly. The second copies
    ``leaves`` and ``inputs`` into static buffers (the leaves' require
    grad), captures ``fn`` with autograd recording into the forward graph
    and replays it, runs ``head`` eagerly on the forward's output (the
    loss, a collective: nothing of it is captured), copies its gradient
    into the backward graph's static input, then captures
    ``torch.autograd.grad`` of the output with respect to the static
    leaves into the backward graph (zeros for a leaf ``fn`` does not use,
    decided here) and replays it. Every later call copies its inputs in,
    replays the forward, runs ``head``, copies its gradient in and replays
    the backward. The forward's saved tensors live in the pool until the
    backward has replayed; a kernel that the backward launches again from
    an input (the sampler's redraw from the key) reads the static buffer,
    which no copy changes between the two replays. The grads returned are
    copies; ``head``'s value is its own. A capture that fails raises and
    leaves the step as it was before it (the next call captures again);
    nothing falls back to the eager step.

    Launches are tallied as ``GraphStep`` tallies them, the forward's and
    the backward's together: ``launches`` is what both captures recorded,
    ``capture_s``, ``instantiate_s`` and ``pool_bytes`` cover both. Under
    a profiler a replayed call records the ``telemetry`` spans of the train
    step's parts: ``train.forward`` (copy-in and the forward replay),
    ``train.loss`` (``head`` and its gradient) and ``train.backward`` (the
    backward replay and the gradients' copies); the eager split records
    the same three."""

    def __init__(self, device: torch.device) -> None:
        super().__init__(device)
        self.backward = None
        self.static_grad_out = self.static_grads = None

    def __call__(self, fn, leaves, inputs, head) -> tuple:
        self.calls += 1
        if self.calls == 1:
            return split_value_and_grad(fn, leaves, inputs, head)
        with torch.cuda.device(self.device):
            if self.graph is None:
                value = self._capture(fn, leaves, inputs, head)
            else:
                with telemetry.span("train.forward"):
                    with torch.no_grad():
                        for static, x in zip(self.static_in, [*leaves, *inputs]):
                            static.copy_(x, non_blocking=True)
                    self.graph.replay()
                with telemetry.span("train.loss"):
                    value, g = _head_grad(head, self.static_out)
                    self.static_grad_out.copy_(g)
            with telemetry.span("train.backward"):
                self.backward.replay()
                self.replays += 1
                GraphStep.replayed.update(self.launches)
                return value, [g.clone() for g in self.static_grads]

    def _capture(self, fn, leaves, inputs, head):
        """Captures both graphs and replays the forward; returns ``head``'s
        value. The step's state is set only once both captures are done."""
        static_in = [x.detach().clone() for x in (*leaves, *inputs)]
        xs = [x.requires_grad_() for x in static_in[:len(leaves)]]
        forward = torch.cuda.CUDAGraph(keep_graph=True)
        backward = torch.cuda.CUDAGraph(keep_graph=True)
        with _no_collection(self.device):
            before = COUNTS.snapshot()
            with torch.enable_grad():
                out, fwd_s, fwd_bytes = _record(forward, self.device, lambda: fn(*static_in))
            fwd_inst = _instantiate(forward)
            forward.replay()
            value, g = _head_grad(head, out)
            grad_out = g.clone()
            grads, bwd_s, bwd_bytes = _record(
                backward, self.device, lambda: _zeros_for_unused(
                    torch.autograd.grad(out, xs, grad_out, allow_unused=True), xs),
                pool=forward.pool())
        self.instantiate_s = fwd_inst + _instantiate(backward)
        self.capture_s, self.pool_bytes = fwd_s + bwd_s, fwd_bytes + bwd_bytes
        self.launches = _launched_since(before)
        GraphStep.recorded.update(self.launches)
        # the output without its autograd nodes, whose saved tensors the
        # backward's capture has released to the pool
        self.static_in, self.static_out = static_in, out.detach()
        self.static_grad_out, self.static_grads = grad_out, grads
        self.graph, self.backward = forward, backward
        GraphStep.captures += 1
        return value


class _Graphs:
    """The graph steps of one factory's step, least recently used first:
    one per (scene, intersector, ray order, variant). A graph holds the
    addresses of the scene's tables, so its entry lives only as long as the
    scene: it holds a weak reference, and the scene's death drops the entry
    with its graph and the graph's pool. The intersector is part of the key
    because ``make_trace_fn`` reads ``ISAKLM_INTERSECTOR`` and
    ``ISAKLM_BLK_SORT`` when it is called, and a graph replays the kernels
    of its capture. ``last`` is the step of the latest call; ``kind`` the
    class of the steps (``GraphStep`` or ``GradGraphStep``)."""

    def __init__(self, maxsize: int = 8, kind=GraphStep) -> None:
        self.maxsize = maxsize
        self.kind = kind
        self.entries = collections.OrderedDict()  # key -> (weakref to scene, step)
        self.last = None

    def get(self, scene: Scene, variant) -> GraphStep:
        sort = blk_sort_mode() if scene.cbvh is not None else None
        key = (id(scene), trace_name(scene), sort, variant)
        entry = self.entries.get(key)
        if entry is not None and entry[0]() is scene:
            self.entries.move_to_end(key)
        else:
            ref = weakref.ref(scene, functools.partial(self._drop, key))
            entry = self.entries[key] = (ref, self.kind(scene.device))
            if len(self.entries) > self.maxsize:
                self.entries.popitem(last=False)
        self.last = entry[1]
        return self.last

    def _drop(self, key, ref) -> None:
        """The weak reference's callback: its scene has died."""
        entry = self.entries.get(key)
        if entry is not None and entry[0] is ref:
            del self.entries[key]
            if self.last is entry[1]:
                self.last = None


def _on_card(scene: Scene) -> bool:
    return scene.device.type == "cuda"


_CAMERA_LEAVES = len(dataclasses.fields(Camera))


def _key_on(key_words, device: torch.device) -> torch.Tensor:
    """The key words as a (2,) int64 tensor on ``device``, copied from
    pinned memory without waiting."""
    if isinstance(key_words, torch.Tensor):
        return rng.key_tensor(key_words, device)
    return rng.key_tensor(key_words).pin_memory().to(device, non_blocking=True)


def _graph_tensors(run):
    """``run(scene, camera, tensors, key_words, variant)`` (``tensors`` a
    tuple of tensors; it returns a tuple of tensors) as a step of the same
    arguments, under ``torch.no_grad()``: on the card it replays a CUDA
    graph (``GraphStep``), one per scene, intersector, ray order and
    ``variant``; on the CPU it is ``run``. The camera, ``tensors`` and the
    key words are the graph's inputs, copied in at every call. ``.graphs``
    holds its steps."""
    graphs = _Graphs()

    @torch.no_grad()
    def step(scene: Scene, camera: Camera, tensors: tuple, key_words, variant=None) -> tuple:
        if not _on_card(scene):
            return tuple(run(scene, camera, tuple(tensors), key_words, variant))

        def fn(*leaves):
            cam = Camera(*leaves[:_CAMERA_LEAVES])
            return tuple(run(scene, cam, leaves[_CAMERA_LEAVES:-1], leaves[-1], variant))

        inputs = [*(getattr(camera, f.name) for f in dataclasses.fields(camera)), *tensors,
                  _key_on(key_words, scene.device)]
        return graphs.get(scene, variant)(fn, inputs)

    step.graphs = graphs
    return step


def _graph_steps(run):
    """``run(scene, camera, gbuffer, extra, key_words, variant)`` (``extra``
    a tuple of tensors; it returns a GBuffer, or a tuple of a GBuffer and
    tensors) as a step of the same arguments over ``_graph_tensors``: the
    G-buffer is among the graph's inputs and outputs. ``.graphs`` holds
    its steps."""

    def flat(scene, cam, tensors, key, variant):
        out = run(scene, cam, GBuffer(*tensors[:3]), tuple(tensors[3:]), key, variant)
        g2, *more = out if isinstance(out, tuple) else (out,)
        return (g2.frame, g2.sq_luminance, g2.count, *more)

    tensors = _graph_tensors(flat)

    def step(scene: Scene, camera: Camera, gb: GBuffer, extra: tuple, key_words, variant=None):
        frame, sq_luminance, count, *more = tensors(
            scene, camera, (gb.frame, gb.sq_luminance, gb.count, *extra), key_words, variant)
        g2 = GBuffer(frame, sq_luminance, count)
        return (g2, *more) if more else g2

    step.graphs = tensors.graphs
    return step


def _grad_graph_steps(run):
    """``run(scene, leaves, inputs, key_words, variant)`` (a tensor,
    differentiable in the tuple ``leaves``) as a step
    ``step(scene, leaves, inputs, key_words, head, variant)`` ->
    ``(value, grads)`` of ``split_value_and_grad``: on the card it replays
    a forward and a backward CUDA graph (``GradGraphStep``), one pair per
    scene, intersector, ray order and ``variant``; on the CPU it is
    ``split_value_and_grad`` of ``run``. The leaves, ``inputs`` and the key
    words are the graphs' inputs, copied in at every call; ``head`` runs
    eagerly between the two replays. ``.graphs`` holds its steps."""
    graphs = _Graphs(kind=GradGraphStep)

    def step(scene: Scene, leaves, inputs, key_words, head, variant=None):
        n, m = len(leaves), len(leaves) + len(inputs)

        def fn(*xs):
            return run(scene, xs[:n], xs[n:m], xs[m], variant)

        if not _on_card(scene):
            return split_value_and_grad(fn, leaves, [*inputs, key_words], head)
        key = _key_on(key_words, scene.device)
        return graphs.get(scene, variant)(fn, leaves, [*inputs, key], head)

    step.graphs = graphs
    return step


@functools.lru_cache(maxsize=8)
def make_active_count_fn(config: RenderConfig):
    """(gbuffer) -> 0-dim int32 tensor: the pixels still needing a sample
    (the JAX package's jitted count). Nothing waits on the device."""

    def count(gb: GBuffer) -> torch.Tensor:
        return needs_sample(gb, config).sum(dtype=torch.int32)

    return count


@functools.lru_cache(maxsize=8)
def make_candidates_fn(config: RenderConfig, bucket: int):
    """(gbuffer) -> ``candidates(gbuffer, config, bucket)``: the (bucket,)
    candidate ids and their count, both left on the device."""

    def cands(gb: GBuffer):
        return candidates(gb, config, bucket)

    return cands


@functools.lru_cache(maxsize=64)
def make_compact_step_fn(config: RenderConfig, bucket: int):
    """step(scene, camera, gbuffer, key_words) -> gbuffer:
    ``compact_step`` at ``bucket``, replayed from a CUDA graph on the card
    (``_graph_steps``), eager on the CPU."""
    steps = _graph_steps(lambda scene, cam, gb, _, key, __: compact_step(
        scene, cam, gb, key, config, bucket))

    def step(scene: Scene, camera: Camera, gb: GBuffer, key_words) -> GBuffer:
        return steps(scene, camera, gb, (), key_words)

    step.graphs = steps.graphs
    return step


@functools.lru_cache(maxsize=64)
def make_tail_step_fn(config: RenderConfig, bucket: int):
    """step(scene, camera, gbuffer, cand, key_words) -> (gbuffer',
    candidates', n_active): ``tail_step`` over a (bucket,) candidate set,
    replayed from a CUDA graph on the card (``_graph_steps``), eager on the
    CPU. n_active is a 0-dim tensor on the device, which the caller reads
    (one sync a step, as the JAX package's ``render``)."""
    steps = _graph_steps(lambda scene, cam, gb, extra, key, _: tail_step(
        scene, cam, gb, extra[0], key, config))

    def step(scene: Scene, camera: Camera, gb: GBuffer, cand: torch.Tensor, key_words):
        return steps(scene, camera, gb, (cand,), key_words)

    step.graphs = steps.graphs
    return step


@functools.lru_cache(maxsize=8)
def make_step_fn(config: RenderConfig):
    """step(scene, camera, gbuffer, key_words, adaptive=True) -> gbuffer:
    ``render_step``, replayed from a CUDA graph on the card
    (``_graph_steps``, one graph per scene, intersector and ``adaptive``),
    eager on the CPU.

    As in the JAX package, the scene and the camera are arguments of the
    step, and the factory caches one step per configuration; the camera,
    the G-buffer and the key words are copied into the graph's inputs at
    every call, so a moving camera or a new sample replays the same
    graph."""
    steps = _graph_steps(lambda scene, cam, gb, _, key, adaptive: render_step(
        scene, cam, gb, key, config, adaptive))

    def step(scene: Scene, camera: Camera, gb: GBuffer, key_words,
             adaptive: bool = True) -> GBuffer:
        return steps(scene, camera, gb, (), key_words, bool(adaptive))

    step.graphs = steps.graphs
    return step


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
    """Render ``num_samples`` progressive steps (main.cu:114-132) through
    the step factories, as the JAX package's ``render`` through its jitted
    steps: on the card every step replays a CUDA graph (``GraphStep``).

    Step i uses the key words of sample ``sample_offset + i`` of ``seed``
    (the JAX package's ``fold_in(PRNGKey(seed), sample_offset + i)``).
    Under a profiler the call, its count reads, its candidate gather and
    each step record ``telemetry`` spans; a step's counts its lanes and
    the active pixels among them, from the counts the loop reads anyway.
    """
    with telemetry.span("render") as call:
        call.count("samples", num_samples)
        call.count("adaptive", int(adaptive))
        device = scene.device
        if gbuffer is None:
            gbuffer = GBuffer.create(config.num_pixels, device)
        step = make_step_fn(config)
        count_active = make_active_count_fn(config) if adaptive else None
        floor = min(config.min_wavefront, config.num_pixels)

        cand = None  # tail-mode candidate ids (ascending, -1 padded)
        bucket = n_active = config.num_pixels
        for i in range(num_samples):
            key_words = rng.sample_key_words(seed, sample_offset + i)
            if adaptive:
                # One host sync per step sizes the wavefront to the
                # unconverged set, like the reference's per-thread skip
                # (path_tracing.cuh:347-379).
                if cand is None:
                    with telemetry.span("render.count"):
                        n_active = int(count_active(gbuffer))
                    if n_active == 0:
                        break
                    bucket = compact_bucket(n_active, config.num_pixels, floor)
                    if bucket < config.num_pixels:
                        # tail mode: one O(num_pixels) candidate gather,
                        # then every step is O(bucket) (the active set only
                        # shrinks)
                        with telemetry.span("render.candidates"):
                            cand, _ = make_candidates_fn(config, bucket)(gbuffer)
                if cand is not None:
                    with telemetry.span("render.tail") as s:
                        gbuffer, cand, n_dev = make_tail_step_fn(config, bucket)(
                            scene, camera, gbuffer, cand, key_words
                        )
                        # the step's own count of the candidates it sampled
                        with telemetry.span("render.count"):
                            n_active = int(n_dev)
                        s.count("lanes", bucket)
                        s.count("active", n_active)
                    if n_active == 0:
                        break
                    nb = compact_bucket(n_active, config.num_pixels, floor)
                    if nb < bucket:
                        cand = cand[:nb]  # actives are compacted to the front
                        bucket = nb
                    continue
            with telemetry.span("render.step") as s:
                gbuffer = step(scene, camera, gbuffer, key_words, adaptive)
                s.count("lanes", config.num_pixels)
                s.count("active", n_active)
    return gbuffer
