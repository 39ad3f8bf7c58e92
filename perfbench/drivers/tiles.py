"""The image over several cards: the CLI's ``--devices N`` path.

``dist.launch`` starts one rank a card (NCCL); each builds the scene and
renders images of ``samples`` samples (the adaptive floor, so every pixel
samples every step) back to back through ``dist.sharding.render_sharded``
over a (N, 1) tile mesh with the adaptive gate on, each image from a
fresh G-buffer and a render seed of its own drawn from ``--seed``,
gathered by ``unshard_gbuffer`` and resolved once on rank 0, which copies
it to the host. Rank 0 ends the window between images and tells the
others by an all_reduce. The pixel-samples of the gathered G-buffers give
``rays_per_s``.

Set-up (imports, the scene, a warm-up render that runs, captures and
replays the rank's step, and a gather) runs in every rank; ``setup_s``
runs from the harness's start to rank 0's first timed image. With
``--trace 1`` rank 0 profiles its window; the memory peak is the fullest
card's.

The check: in the last image, ``check_pixels`` pixels drawn from the
seed, every sample traced again by the reference, their sums, counts and
colours against the gathered G-buffer and rank 0's host image. Each rank
reports the JAX modules its process loaded; any refuses the run.
"""

from __future__ import annotations

import time

import torch

from perfbench import core
from perfbench.core import Window
from perfbench.drivers import common


def rank_main(rank: int, world: int, ctx, t0_wall: float, fault=None) -> dict:
    """One rank's set-up and window. ``fault`` plants one of
    ``faults.FAULTS`` in this rank's timed path (a patch in the harness's
    process does not reach a spawned rank)."""
    from perfbench import faults

    with faults.planted(fault, ctx):
        return _rank(rank, world, ctx, t0_wall)


def _rank(rank: int, world: int, ctx, t0_wall: float) -> dict:
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.dist.sharding import (make_render_mesh, render_sharded,
                                                          unshard_gbuffer)
    from isaklm_raytracer_tpu_torch.integrator.render import resolve_image

    t = ctx.traffic
    device = torch.device("cuda", rank) if ctx.device.type == "cuda" else torch.device("cpu")
    arrays = common.scene_arrays(ctx.config)
    scene = common.program_scene(arrays, device)
    config = common.render_config(ctx.config)
    camera = common.program_camera(ctx.config, device)
    mesh = make_render_mesh(world, 1, device)

    def image(seed: int, samples: int):
        shard = render_sharded(scene, camera, config, samples, mesh, seed=seed, adaptive=True)
        full = unshard_gbuffer(shard, config, mesh)
        return full, resolve_image(full, config).cpu() if rank == 0 else None

    image(common.word(ctx.seed, 10), t["warmup_samples"])
    common.sync(device)
    seconds = ctx.seconds
    profile = None
    if ctx.trace:
        seconds = min(seconds, float(t.get("trace_seconds", seconds)))
        if rank == 0:
            from perfbench import trace as tracing

            profile = tracing.cuda_profile()
            prof = profile.__enter__()
    flag = torch.zeros((1,), dtype=torch.int32, device=device)
    setup_s = time.time() - t0_wall
    start = time.perf_counter()
    images = samples = 0
    while True:
        seed = common.word(ctx.seed, 20, images)
        full, host = image(seed, t["samples"])
        samples += int(full.count.sum(dtype=torch.int64))
        images += 1
        flag.fill_(int(time.perf_counter() - start >= seconds))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if int(flag) > 0:
            break
    common.sync(device)
    elapsed = time.perf_counter() - start
    summary = None
    if profile is not None:
        profile.__exit__(None, None, None)
        summary = tracing.summarize(tracing.device_records(prof), images * t["samples"],
                                    samples * config.max_bounces * 2.0, t["kind"], images)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    # what this rank's process loaded, which the harness's own look misses
    forbidden = core.forbidden_modules()
    if rank != 0:
        return {"peak": peak, "forbidden": forbidden}
    pixels = common.draw_pixels(ctx.seed, config.num_pixels, t["check_pixels"], 3)
    ids = torch.as_tensor(pixels, device=device)
    return {"peak": peak, "forbidden": forbidden, "setup_s": setup_s, "elapsed": elapsed, "images": images,
            "samples": samples, "summary": summary, "lights": common.light_order(arrays, scene),
            "seed": seed, "pixels": pixels, "frame": full.frame[ids].cpu(),
            "count": full.count[ids].cpu(), "image": host.reshape(-1, 3)[ids.cpu()]}


class Cell:
    traces_itself = True  # its rank 0 profiles its own window

    def __init__(self, ctx, fault=None) -> None:
        self.ctx, self.fault = ctx, fault
        self.arrays = common.scene_arrays(ctx.config)

    def window(self, seconds: float, t0: float) -> Window:
        from isaklm_raytracer_tpu_torch.dist.launch import launch

        t0_wall = time.time() - (time.perf_counter() - t0)
        ctx = self.ctx
        outs = launch(rank_main, ctx.cell["chips"], ctx, t0_wall, self.fault,
                      device="cuda" if ctx.device.type == "cuda" else "cpu")
        found = sorted({m for o in outs for m in o["forbidden"]})
        if found:
            raise core.Forbidden(f"a rank's process loaded {found}")
        self.out = outs[0]
        self.peak = max(o["peak"] for o in outs)
        self.summary = self.out["summary"]
        rays = self.out["samples"] * ctx.config["max_bounces"] * 2.0
        return Window(self.out["elapsed"], self.out["images"],
                      {"setup_s": self.out["setup_s"], "rays_per_s": rays / self.out["elapsed"]},
                      steps=self.out["images"] * ctx.traffic["samples"], rays=rays)

    def release(self) -> None:
        """The ranks have ended, and their state with them."""

    def checked_units(self) -> int:
        return 1

    def reference(self, dtype=torch.float32):
        """(frame, count) of the checked pixels by the reference in
        ``dtype``."""
        return common.sample_sums(self.arrays, self.out["lights"], self.ctx.config,
                                  self.out["seed"], self.ctx.traffic["samples"],
                                  self.out["pixels"], self.ctx.traffic["check_batch"],
                                  dtype=dtype, device=self.ctx.device)

    def check(self, frame=None, count=None) -> list:
        """The checks of the last image (or of ``frame`` and ``count`` put
        in its place)."""
        if not hasattr(self, "_ref"):
            self._ref = self.reference()
        own = frame is None
        return common.pixel_checks(
            self.ctx.traffic["limits"], self.out["frame"] if own else frame,
            self.out["count"] if own else count, self.out["image"] if own else None,
            *self._ref)


def control(cell: Cell) -> list:
    """The checks with the reference in bfloat16 put in the program's
    place."""
    frame, count = cell.reference(torch.bfloat16)
    return cell.check(frame.float(), count)
