"""Multi-device rendering and inverse rendering over torch.distributed.

Port of ``isaklm_raytracer_tpu/dist/sharding.py``. The JAX package drives
every device from one controller through ``shard_map``; here each card has
a process of its own (a rank, as torchrun or ``dist.launch`` start them),
and the ranks meet in the default process group, which the caller sets up.

- A ("tile", "sample") mesh over the ranks: pixels are split over "tile",
  independent sample streams over "sample"; the scene and the materials
  are replicated (every rank holds its own copy).
- Rendering: each rank traces its own slice of the pixels with keys
  derived from the GLOBAL pixel ids, so with one sample stream the
  sharded render equals the single-device one bit for bit. Several
  streams are averaged by one all_reduce over the ranks of a tile.
- Training (inverse rendering): each rank takes the loss over its own
  pixels and runs its backward locally; the loss and the gradients of the
  replicated parameters are then summed over every rank by one all_reduce.
- Steps: where the JAX package jits a step, a rank on the card replays
  CUDA graphs (``_RankSteps``): the render and tail steps and the
  sharded sample as ``integrator.render``'s graph steps, the gradient as
  a forward and a backward graph. Every collective runs between the
  replays, never inside a capture (gloo cannot be captured). The active
  counts, the progress reductions and the train step's update stay
  eager.

The collectives are the list forms that both gloo and NCCL take, on
tensors on the rank's device; nothing here picks a backend.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

from isaklm_raytracer_tpu_torch import telemetry
from isaklm_raytracer_tpu_torch.camera.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.render import (
    _grad_graph_steps,
    _graph_steps,
    _graph_tensors,
    add_sample,
    candidates,
    compact_bucket,
    render_sample,
    render_step,
    scatter_sample,
    step_radiance,
    tail_radiance,
    tail_step,
)
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.types import GBuffer, MaterialTable, Scene

FLOAT_FIELDS = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent")
POSE_FIELDS = ("camera_position", "camera_yaw", "camera_pitch")


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """This rank's place in a ("tile", "sample") mesh of ranks: rank r sits
    at tile r // num_sample and sample stream r % num_sample."""

    num_tile: int
    num_sample: int
    rank: int
    device: torch.device
    sample_group: object  # the ranks of this rank's tile
    tile_group: object  # the ranks of this rank's sample stream, in tile order

    @property
    def tile(self) -> int:
        return self.rank // self.num_sample

    @property
    def sample(self) -> int:
        return self.rank % self.num_sample


def make_render_mesh(num_tile: Optional[int] = None, num_sample: int = 1,
                     device="cuda") -> RenderMesh:
    """A ("tile", "sample") mesh over the ranks of the default process
    group, laid out as the JAX package's ``devices.reshape(num_tile,
    num_sample)``. Collective: every rank calls it, with the same shape.

    ``device`` "cuda" is this rank's card, ``cuda:LOCAL_RANK`` (LOCAL_RANK
    as torchrun and ``dist.launch`` set it, 0 when unset); "cpu" or a card
    by index are taken as they are. Raises when no group is up and when
    the mesh does not cover the group's ranks exactly."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_render_mesh: no process group is up; call "
            "torch.distributed.init_process_group first (dist.launch and torchrun do)"
        )
    world = dist.get_world_size()
    if num_tile is None:
        num_tile = world // num_sample
    if num_tile * num_sample != world:
        raise ValueError(f"mesh {num_tile}x{num_sample} != {world} ranks")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = resolve_device(device)
    # new_group is collective over the whole group: every rank builds every
    # subgroup, in the same order, and keeps its own
    sample_groups = [dist.new_group([t * num_sample + s for s in range(num_sample)])
                     for t in range(num_tile)]
    tile_groups = [dist.new_group([t * num_sample + s for t in range(num_tile)])
                   for s in range(num_sample)]
    rank = dist.get_rank()
    return RenderMesh(num_tile, num_sample, rank, device,
                      sample_groups[rank // num_sample], tile_groups[rank % num_sample])


def _pad_pixels(config: RenderConfig, num_tile: int) -> int:
    """Pixels per tile shard, padded so the count divides evenly."""
    return -(-config.num_pixels // num_tile)


def _tile_layout(config: RenderConfig, mesh: RenderMesh):
    """(per_tile, ids, pvalid): this rank's (per_tile,) slice of the padded
    pixel ids (the padding repeats num_pixels - 1) and the mask of its real
    pixels, on the rank's device."""
    per_tile = _pad_pixels(config, mesh.num_tile)
    start = mesh.tile * per_tile
    ids = torch.arange(start, start + per_tile, dtype=torch.int32, device=mesh.device)
    return per_tile, torch.clamp_max(ids, config.num_pixels - 1), ids < config.num_pixels


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The concatenation over ``group``'s ranks, in group order, of their
    equal-shaped ``x``."""
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _all_reduce(x: torch.Tensor, op, group=None) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=group)
    return x


def _mean_streams(radiance: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """The mean over the mesh's sample streams (JAX's ``pmean`` over
    "sample"): a SUM all_reduce over the ranks of a tile, then the
    division."""
    return _all_reduce(radiance, dist.ReduceOp.SUM, mesh.sample_group) / mesh.num_sample


def shard_gbuffer(gbuffer: GBuffer, config: RenderConfig, mesh: RenderMesh) -> GBuffer:
    """This rank's (per_tile,) slice of a plain (num_pixels,) G-buffer,
    zero-padded, on the rank's device (replicated over "sample"). Local:
    every rank holds the plain buffer."""
    per_tile = _pad_pixels(config, mesh.num_tile)
    lo = mesh.tile * per_tile

    def part(x):
        x = x[lo:lo + per_tile].to(mesh.device)
        pad = per_tile - x.shape[0]
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x

    return GBuffer(part(gbuffer.frame), part(gbuffer.sq_luminance), part(gbuffer.count))


def unshard_gbuffer(gbuffer: GBuffer, config: RenderConfig, mesh: RenderMesh) -> GBuffer:
    """The plain (num_pixels,) G-buffer from the tile shards, on every
    rank. Collective, like JAX's ``process_allgather``: every rank must
    call it."""
    n = config.num_pixels
    return GBuffer(*(_all_gather(x, mesh.tile_group, mesh.num_tile)[:n]
                     for x in (gbuffer.frame, gbuffer.sq_luminance, gbuffer.count)))


class _RankSteps:
    """The graph steps of a rank at one configuration (``_rank_steps``),
    each a ``_graph_steps``, ``_graph_tensors`` or ``_grad_graph_steps``
    whose variant starts with the mesh's shape and the rank
    (``_variant``): on the card a rank replays CUDA graphs, as the JAX
    package's jitted steps, and every collective runs between them, never
    inside a capture; on the CPU each is its eager function.

    - ``sample``: ``render_sample`` over the rank's pixels
      (``sharded_render_fn``);
    - ``step`` and ``tail``: ``render_step`` and ``tail_step`` whole, with
      one sample stream (nothing to reduce);
    - ``step_radiance`` and ``tail_radiance``: their halves before the
      mean over several streams, which runs eagerly, as does the
      accumulation after it;
    - ``vg``: the radiance of ``sharded_value_and_grad_fn``'s objective,
      its forward and backward captured (``GradGraphStep``); the loss runs
      between them."""

    def __init__(self, config: RenderConfig) -> None:
        self.sample = _graph_tensors(lambda scene, cam, t, key, _: (render_sample(
            scene, cam, key, config, pixel_ids=t[0]),))
        self.step = _graph_steps(lambda scene, cam, gb, extra, key, variant: render_step(
            scene, cam, gb, key, config, variant[-1], pixel_ids=extra[0], valid=extra[1]))
        self.step_radiance = _graph_tensors(lambda scene, cam, t, key, variant: step_radiance(
            scene, cam, GBuffer(*t[:3]), key, config, variant[-1], pixel_ids=t[3], valid=t[4]))
        self.tail = _graph_steps(lambda scene, cam, gb, extra, key, _: tail_step(
            scene, cam, gb, extra[0], key, config, pixel_ids=extra[1]))
        self.tail_radiance = _graph_tensors(lambda scene, cam, t, key, _: tail_radiance(
            scene, cam, GBuffer(*t[:3]), t[3], key, config, pixel_ids=t[4]))
        self.vg = _grad_graph_steps(functools.partial(_objective_radiance, config=config))


@functools.lru_cache(maxsize=8)
def _rank_steps(config: RenderConfig) -> _RankSteps:
    return _RankSteps(config)


def _variant(mesh: RenderMesh, *more) -> tuple:
    """A rank's graph key beside the scene's: the mesh's shape, the rank
    and ``more``."""
    return (mesh.num_tile, mesh.num_sample, mesh.rank, *more)


def sharded_render_fn(scene: Scene, config: RenderConfig, mesh: RenderMesh):
    """Returns (run, num_sample): run(camera, key_words) -> the (H*W, 3)
    radiance of one sample, averaged over the mesh's sample streams, on
    every rank (collective). Stream s draws with ``rng.fold_in(key_words,
    s)``, so one call adds ``num_sample`` samples per pixel. On the card
    the rank's sample replays a CUDA graph; the mean over streams and the
    gather run after it."""
    _, ids, _ = _tile_layout(config, mesh)
    sample = _rank_steps(config).sample

    @torch.no_grad()
    def run(camera: Camera, key_words) -> torch.Tensor:
        (radiance,) = sample(scene, camera, (ids,), rng.fold_in(key_words, mesh.sample),
                             _variant(mesh))
        radiance = _mean_streams(radiance, mesh)
        return _all_gather(radiance, mesh.tile_group, mesh.num_tile)[:config.num_pixels]

    return run, mesh.num_sample


def _stream(mesh: RenderMesh, key_words):
    """(key words, radiance reduction) of this rank's sample stream: one
    stream keeps the single-device key sequence and reduces nothing, which
    keeps the sharded render bit-equal to one device."""
    if mesh.num_sample == 1:
        return key_words, None
    return rng.fold_in(key_words, mesh.sample), lambda r: _mean_streams(r, mesh)


def _max_over_ranks(n: int, mesh: RenderMesh) -> int:
    """JAX's ``pmax`` over ("tile", "sample") of a host count."""
    t = torch.tensor([n], dtype=torch.int64, device=mesh.device)
    return int(_all_reduce(t, dist.ReduceOp.MAX))


def _sharded_step(scene, camera, gb, key_words, config, mesh, adaptive, ids, pvalid):
    """The uniform progressive step on this rank's shard (masked by the
    adaptive gate and the padding); the tile-sharded G-buffer accumulates
    locally. One graph with one sample stream; with several, the
    radiance's graph, then the mean over streams and the accumulation."""
    key_words, reduce = _stream(mesh, key_words)
    steps, variant = _rank_steps(config), _variant(mesh, bool(adaptive))
    if reduce is None:
        return steps.step(scene, camera, gb, (ids, pvalid), key_words, variant)
    radiance, took = steps.step_radiance(
        scene, camera, (gb.frame, gb.sq_luminance, gb.count, ids, pvalid), key_words, variant)
    return add_sample(gb, reduce(radiance), took)


def _sharded_active_count(gb, config, mesh, pvalid) -> int:
    """The most unconverged pixels any rank holds (one host read a step
    before tail mode)."""
    return _max_over_ranks(int((needs_sample(gb, config) & pvalid).sum()), mesh)


def _sharded_tail_step(scene, camera, gb, cand, key_words, config, mesh, ids):
    """``integrator.render.tail_step`` over this rank's candidate set;
    returns (gbuffer', candidates', the most actives on any rank). One
    graph a bucket with one sample stream; with several, the radiance's
    graph, then the mean over streams and the scatter-add. The count's host
    read and its MAX over the ranks follow the replay."""
    key_words, reduce = _stream(mesh, key_words)
    steps, variant = _rank_steps(config), _variant(mesh, cand.shape[0])
    if reduce is None:
        gb, cand, n = steps.tail(scene, camera, gb, (cand, ids), key_words, variant)
    else:
        radiance, rids, valid, cand, n = steps.tail_radiance(
            scene, camera, (gb.frame, gb.sq_luminance, gb.count, cand, ids), key_words, variant)
        gb = scatter_sample(gb, rids.long(), reduce(radiance), valid)
    return gb, cand, _max_over_ranks(int(n), mesh)


def gbuffer_progress(gbuffer: GBuffer, config: RenderConfig, mesh: RenderMesh):
    """(min spp, converged fraction, unconverged count) of the whole image
    from this rank's shard, on every rank (collective: MIN and SUM
    all_reduces over the tile axis)."""
    _, _, pvalid = _tile_layout(config, mesh)
    big = torch.iinfo(torch.int32).max
    low = torch.where(pvalid, gbuffer.count, big).min().reshape(1).to(torch.int64)
    sums = torch.stack([
        (pvalid & (gbuffer.count >= config.min_samples)).sum(),
        (needs_sample(gbuffer, config) & pvalid).sum(),
    ]).to(torch.int64)
    _all_reduce(low, dist.ReduceOp.MIN, mesh.tile_group)
    _all_reduce(sums, dist.ReduceOp.SUM, mesh.tile_group)
    conv, needs = sums.tolist()
    return int(low), conv / config.num_pixels, needs


@torch.no_grad()
def render_sharded(
    scene: Scene,
    camera: Camera,
    config: RenderConfig,
    num_samples: int,
    mesh: RenderMesh,
    seed: int = 0,
    adaptive: bool = False,
    gbuffer: Optional[GBuffer] = None,
    sample_offset: int = 0,
) -> GBuffer:
    """The sharded counterpart of ``integrator.render.render``: the same key
    sequence, the same per-pixel adaptive gate and the same compaction
    ladder, per rank, so on a (num_tile, 1) mesh the result is bit-equal to
    the single-device loop. Collective. Takes a plain (num_pixels,) or this
    rank's (per_tile,) G-buffer and returns this rank's shard
    (``unshard_gbuffer`` for the plain one).

    The bucket floor per rank is max(min_wavefront // num_tile, 256); the
    bucket is common to all ranks (the MAX of their active counts), the
    candidate sets are each rank's own."""
    per_tile, ids, pvalid = _tile_layout(config, mesh)
    if gbuffer is None:
        gbuffer = GBuffer.create(per_tile, mesh.device)
    elif gbuffer.frame.shape[0] != per_tile:
        gbuffer = shard_gbuffer(gbuffer, config, mesh)
    min_bucket = min(max(config.min_wavefront // mesh.num_tile, 256), per_tile)

    cand = None  # tail-mode candidate ids of this rank (ascending, -1 padded)
    bucket = per_tile
    for i in range(num_samples):
        key_words = rng.sample_key_words(seed, sample_offset + i)
        if adaptive:
            if cand is None:
                n_max = _sharded_active_count(gbuffer, config, mesh, pvalid)
                if n_max == 0:
                    break
                bucket = compact_bucket(n_max, per_tile, min_bucket)
                if bucket < per_tile:
                    # tail mode: one O(per_tile) scan per rank, then every
                    # step is O(bucket) (the active sets only shrink)
                    cand, _ = candidates(gbuffer, config, bucket, valid=pvalid)
            if cand is not None:
                gbuffer, cand, n_max = _sharded_tail_step(
                    scene, camera, gbuffer, cand, key_words, config, mesh, ids)
                if n_max == 0:
                    break
                nb = compact_bucket(n_max, per_tile, min_bucket)
                if nb < bucket:
                    cand = cand[:nb]  # actives are compacted to the front
                    bucket = nb
                continue
        gbuffer = _sharded_step(scene, camera, gbuffer, key_words, config, mesh, adaptive, ids,
                                pvalid)
    return gbuffer


def _previous_stream(x: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """Stream (s - 1) mod n's ``x`` on stream s: JAX's ``ppermute`` with
    perm [(i, (i + 1) % n)] over "sample", by an all_gather."""
    if mesh.num_sample == 1:
        return x
    parts = _all_gather(x, mesh.sample_group, mesh.num_sample).chunk(mesh.num_sample)
    return parts[(mesh.sample - 1) % mesh.num_sample]


def _objective_radiance(scene: Scene, leaves, inputs, key, variant, config: RenderConfig):
    """The radiance ``sharded_value_and_grad_fn`` differentiates: this
    rank's pixels (``inputs``: the materials' tex_id, the camera's fov and
    aperture, the pixel ids) rendered from ``scene`` with the six float
    material fields and the pose (position, yaw, pitch) of ``leaves``."""
    floats, pose = leaves[:len(FLOAT_FIELDS)], leaves[len(FLOAT_FIELDS):]
    tex_id, fov, aperture, ids = inputs
    s = scene.replace(materials=MaterialTable(**dict(zip(FLOAT_FIELDS, floats)), tex_id=tex_id))
    return render_sample(s, Camera(*pose, fov, aperture), key, config, pixel_ids=ids)


def sharded_value_and_grad_fn(scene: Scene, config: RenderConfig, mesh: RenderMesh,
                              decorrelate: bool = False):
    """Returns vg(params, camera, target, key_words) -> (loss, grads);
    collective.

    The loss is the mean squared error between the rendered radiance and
    the (H*W, 3) ``target`` (whole on every rank), averaged over the
    sample streams (stream s draws with ``rng.fold_in(key_words, s)``).
    Each rank renders its tile shard, takes its part of the loss and runs
    its backward through the six float fields of the ``MaterialTable``
    ``params`` and the camera pose; one SUM all_reduce over every rank,
    divided by the stream count, then gives each rank the same loss and
    the same grads: a dict of the six fields and "camera_position",
    "camera_yaw", "camera_pitch".

    On the card the rank's radiance and its backward replay two CUDA
    graphs (``integrator.render.GradGraphStep``, one pair per scene,
    intersector, ray order, mesh shape, rank and ``decorrelate``; the first
    call runs eagerly, the second captures). The loss and its gradient
    with respect to the radiance run eagerly between the two replays, the
    all_gather of ``decorrelate`` among them, and the all_reduce after
    the backward; on the CPU the same split runs eagerly. ``vg.graphs``
    holds the graph steps.

    ``decorrelate=True`` changes the GRADIENT (the reported loss stays the
    MSE) to the dual-buffer estimator: stream s takes the detached
    residual of stream (s - 1) mod n while the derivative flows through
    its own radiance, which removes the Cov(R, dR) bias of the one-sample
    estimator. This is the direction of the JAX package's code
    (``ppermute`` i -> i + 1), whose docstring says "s+1"; the two agree
    at two streams. With one stream it is the plain estimator."""
    per_tile, ids, valid = _tile_layout(config, mesh)
    lo = mesh.tile * per_tile
    rows = max(min(per_tile, config.num_pixels - lo), 0)  # the tile's real pixels
    norm = 3.0 * config.num_pixels
    # the target's slice, zero-padded: a buffer of its own, copied into
    target = torch.zeros((per_tile, 3), dtype=torch.float32, device=mesh.device)
    steps = _rank_steps(config).vg
    variant = _variant(mesh, bool(decorrelate))

    def head(radiance):
        err = torch.where(valid[:, None], radiance - target, 0.0)
        mse = torch.sum(err * err) / norm
        if not decorrelate:
            return mse, mse
        return mse, 2.0 * torch.sum(_previous_stream(err.detach(), mesh) * radiance) / norm

    def vg(params: MaterialTable, camera: Camera, t: torch.Tensor, key_words):
        target[:rows].copy_(t[lo:lo + rows])
        leaves = [*(getattr(params, f) for f in FLOAT_FIELDS),
                  camera.position, camera.yaw, camera.pitch]
        inputs = [params.tex_id, camera.fov, camera.aperture_radius, ids]
        mse, grads = steps(scene, leaves, inputs, rng.fold_in(key_words, mesh.sample), head,
                           variant)
        with telemetry.span("train.all_reduce"):
            flat = torch.cat([mse.reshape(1)] + [g.reshape(-1) for g in grads])
            flat = _all_reduce(flat, dist.ReduceOp.SUM) / mesh.num_sample
        out, at = {}, 1
        for name, g in zip(FLOAT_FIELDS + POSE_FIELDS, grads):
            out[name] = flat[at:at + g.numel()].reshape(g.shape)
            at += g.numel()
        return flat[0], out

    vg.graphs = steps.graphs
    return vg


def sharded_train_step_fn(scene: Scene, config: RenderConfig, mesh: RenderMesh,
                          learning_rate: float = 0.05, decorrelate: bool = True):
    """Returns train_step(params, camera, target, key_words) -> (params,
    loss): one SGD step of inverse rendering on the material floats over
    ``sharded_value_and_grad_fn``; the camera-pose grads are reported by
    that function and not stepped. Collective.

    Defaults to the decorrelated gradient, as the JAX package: its stable
    operating point on the Cornell recovery task is lr 0.1-0.3 with two or
    more sample streams. The gradient replays ``vg``'s graphs on the card
    (``train_step.graphs``); the update runs eagerly. Under a profiler a
    step records the ``telemetry`` span ``train.step``, and in it those of
    its forward, loss, backward, all_reduce and update."""
    vg = sharded_value_and_grad_fn(scene, config, mesh, decorrelate=decorrelate)

    def train_step(params: MaterialTable, camera: Camera, target: torch.Tensor, key_words):
        with telemetry.span("train.step"):
            loss, grads = vg(params, camera, target, key_words)
            with telemetry.span("train.update"):
                return params.replace(**{
                    f: getattr(params, f).detach() - learning_rate * grads[f]
                    for f in FLOAT_FIELDS
                }), loss

    train_step.graphs = vg.graphs
    return train_step
