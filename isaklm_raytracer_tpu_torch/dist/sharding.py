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

The collectives are the list forms that both gloo and NCCL take, on
tensors on the rank's device; nothing here picks a backend.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from isaklm_raytracer_tpu_torch.camera.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.render import (
    candidates,
    compact_bucket,
    make_trace_fn,
    render_sample,
    render_step,
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


def sharded_render_fn(scene: Scene, config: RenderConfig, mesh: RenderMesh):
    """Returns (run, num_sample): run(camera, key_words) -> the (H*W, 3)
    radiance of one sample, averaged over the mesh's sample streams, on
    every rank (collective). Stream s draws with ``rng.fold_in(key_words,
    s)``, so one call adds ``num_sample`` samples per pixel."""
    _, ids, _ = _tile_layout(config, mesh)
    trace_fn = make_trace_fn(scene, config)

    @torch.no_grad()
    def run(camera: Camera, key_words) -> torch.Tensor:
        radiance = render_sample(scene, camera, rng.fold_in(key_words, mesh.sample), config,
                                 trace_fn=trace_fn, pixel_ids=ids)
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


def _sharded_step(scene, camera, gb, key_words, config, mesh, adaptive, trace_fn, ids, pvalid):
    """The uniform progressive step on this rank's shard (masked by the
    adaptive gate and the padding); the tile-sharded G-buffer accumulates
    locally."""
    key_words, reduce = _stream(mesh, key_words)
    return render_step(scene, camera, gb, key_words, config, adaptive, trace_fn,
                       pixel_ids=ids, valid=pvalid, reduce=reduce)


def _sharded_active_count(gb, config, mesh, pvalid) -> int:
    """The most unconverged pixels any rank holds (one host read a step
    before tail mode)."""
    return _max_over_ranks(int((needs_sample(gb, config) & pvalid).sum()), mesh)


def _sharded_tail_step(scene, camera, gb, cand, key_words, config, mesh, trace_fn, ids):
    """``integrator.render.tail_step`` over this rank's candidate set;
    returns (gbuffer', candidates', the most actives on any rank)."""
    key_words, reduce = _stream(mesh, key_words)
    gb, cand, n = tail_step(scene, camera, gb, cand, key_words, config, trace_fn,
                            pixel_ids=ids, reduce=reduce)
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
    trace_fn = make_trace_fn(scene, config)
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
                    scene, camera, gbuffer, cand, key_words, config, mesh, trace_fn, ids)
                if n_max == 0:
                    break
                nb = compact_bucket(n_max, per_tile, min_bucket)
                if nb < bucket:
                    cand = cand[:nb]  # actives are compacted to the front
                    bucket = nb
                continue
        gbuffer = _sharded_step(scene, camera, gbuffer, key_words, config, mesh, adaptive,
                                trace_fn, ids, pvalid)
    return gbuffer


def _previous_stream(x: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """Stream (s - 1) mod n's ``x`` on stream s: JAX's ``ppermute`` with
    perm [(i, (i + 1) % n)] over "sample", by an all_gather."""
    if mesh.num_sample == 1:
        return x
    parts = _all_gather(x, mesh.sample_group, mesh.num_sample).chunk(mesh.num_sample)
    return parts[(mesh.sample - 1) % mesh.num_sample]


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

    ``decorrelate=True`` changes the GRADIENT (the reported loss stays the
    MSE) to the dual-buffer estimator: stream s takes the detached
    residual of stream (s - 1) mod n while the derivative flows through
    its own radiance, which removes the Cov(R, dR) bias of the one-sample
    estimator. This is the direction of the JAX package's code
    (``ppermute`` i -> i + 1), whose docstring says "s+1"; the two agree
    at two streams. With one stream it is the plain estimator."""
    per_tile, ids, valid = _tile_layout(config, mesh)
    trace_fn = make_trace_fn(scene, config)
    lo = mesh.tile * per_tile
    norm = 3.0 * config.num_pixels

    def vg(params: MaterialTable, camera: Camera, target: torch.Tensor, key_words):
        t = target.to(mesh.device)[lo:lo + per_tile]
        t = torch.cat([t, t.new_zeros((per_tile - t.shape[0], 3))])
        leaves = [getattr(params, f).detach().requires_grad_() for f in FLOAT_FIELDS]
        pose = [x.detach().requires_grad_() for x in (camera.position, camera.yaw, camera.pitch)]
        s = scene.replace(materials=params.replace(**dict(zip(FLOAT_FIELDS, leaves))))
        cam = camera.replace(position=pose[0], yaw=pose[1], pitch=pose[2])
        radiance = render_sample(s, cam, rng.fold_in(key_words, mesh.sample), config,
                                 trace_fn=trace_fn, pixel_ids=ids)
        err = torch.where(valid[:, None], radiance - t, 0.0)
        mse = torch.sum(err * err) / norm
        objective = mse
        if decorrelate:
            objective = 2.0 * torch.sum(_previous_stream(err.detach(), mesh) * radiance) / norm
        grads = torch.autograd.grad(objective, leaves + pose, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves + pose)]
        flat = torch.cat([mse.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        flat = _all_reduce(flat, dist.ReduceOp.SUM) / mesh.num_sample
        out, at = {}, 1
        for name, g in zip(FLOAT_FIELDS + POSE_FIELDS, grads):
            out[name] = flat[at:at + g.numel()].reshape(g.shape)
            at += g.numel()
        return flat[0], out

    return vg


def sharded_train_step_fn(scene: Scene, config: RenderConfig, mesh: RenderMesh,
                          learning_rate: float = 0.05, decorrelate: bool = True):
    """Returns train_step(params, camera, target, key_words) -> (params,
    loss): one SGD step of inverse rendering on the material floats over
    ``sharded_value_and_grad_fn``; the camera-pose grads are reported by
    that function and not stepped. Collective.

    Defaults to the decorrelated gradient, as the JAX package: its stable
    operating point on the Cornell recovery task is lr 0.1-0.3 with two or
    more sample streams."""
    vg = sharded_value_and_grad_fn(scene, config, mesh, decorrelate=decorrelate)

    def train_step(params: MaterialTable, camera: Camera, target: torch.Tensor, key_words):
        loss, grads = vg(params, camera, target, key_words)
        return params.replace(**{
            f: getattr(params, f).detach() - learning_rate * grads[f] for f in FLOAT_FIELDS
        }), loss

    return train_step
