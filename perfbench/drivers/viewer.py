"""The interactive viewer: the reference's app loop as
``viewer.InteractiveSession`` with the adaptive gate on.

Each frame is ``step()`` then ``image()`` (the host image). Every
``move_every`` frames a WASD key drawn from the seed, held for
``time_step`` seconds, moves the camera and restarts the accumulation, so
every frame samples every pixel below the sample floor. The frame times
give ``frame_ms_p95``; the pixel-samples the G-buffer counted give
``rays_per_s``.

The check: after the window, ``check_pixels`` pixels drawn from the seed,
every sample since the last move traced again by the reference from its
own camera (the moves replayed), their sums, counts and displayed colours
against the session's.
"""

from __future__ import annotations

import statistics
import time

import torch

from perfbench.core import Window
from perfbench.drivers import common


class Cell:
    def __init__(self, ctx) -> None:
        from isaklm_raytracer_tpu_torch.viewer import InteractiveSession

        self.ctx, t = ctx, ctx.traffic
        self.arrays = common.scene_arrays(ctx.config)
        self.scene = common.program_scene(self.arrays, ctx.device)
        self.config = common.render_config(ctx.config)
        self.render_seed = common.word(ctx.seed, 1)
        draw = common.rng(ctx.seed, 2)
        self.moves = [str(k) for k in draw.choice(t["keys"], size=4096)]
        self.applied = []  # keys applied so far, in order
        self.session = InteractiveSession(self.scene, common.program_camera(ctx.config,
                                                                            ctx.device),
                                          self.config, seed=self.render_seed, adaptive=True)
        self.lights = common.light_order(self.arrays, self.scene)
        # warm-up: the eager step, the capture, replays, a move, the image
        for _ in range(t["warmup_frames"]):
            self._frame(move=False)
        self._move()
        common.sync(ctx.device)

    def _move(self) -> None:
        key = self.moves[len(self.applied) % len(self.moves)]
        self.session.handle_input([key], time_step=self.ctx.traffic["time_step"])
        self.applied.append(key)

    def _frame(self, move: bool):
        if move:
            self._move()
        self.session.step()
        return self.session.image()

    def _count_sum(self) -> int:
        return int(self.session.gbuffer.count.sum(dtype=torch.int64))

    def window(self, seconds: float, t0: float) -> Window:
        every = self.ctx.traffic["move_every"]
        times, samples, since = [], 0, self.session.sample_count
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        now = start
        while now - start < seconds:
            move = since == every
            if move:
                samples += self._count_sum()
                since = 0
            begin = time.perf_counter()
            self.image = self._frame(move)
            now = time.perf_counter()
            times.append(now - begin)
            since += 1
        samples += self._count_sum()
        common.sync(self.ctx.device)
        elapsed = time.perf_counter() - start
        bounces = self.config.max_bounces
        measures = {"setup_s": setup_s,
                    "rays_per_s": samples * bounces * 2 / elapsed,
                    "frame_ms_p95": 1e3 * statistics.quantiles(times, n=20)[-1]
                    if len(times) >= 20 else float("nan")}
        return Window(elapsed, len(times), measures, steps=len(times),
                      rays=float(samples * bounces * 2))

    def release(self) -> None:
        """Keep the G-buffer of the checked pixels and the last image there;
        drop the session, the scene and their graphs."""
        pixels = common.draw_pixels(self.ctx.seed, self.config.num_pixels,
                                    self.ctx.traffic["check_pixels"], 3)
        gb = self.session.gbuffer
        ids = torch.as_tensor(pixels, device=self.ctx.device)
        self.out = {"pixels": pixels, "frame": gb.frame[ids].cpu(), "count": gb.count[ids].cpu(),
                    "image": torch.as_tensor(self.image.reshape(-1, 3)[pixels]),
                    "samples": self.session.sample_count}
        del self.session, self.scene, gb

    def checked_units(self) -> int:
        return 1

    def reference(self, dtype=torch.float32):
        """(frame, count) of the checked pixels by the reference in
        ``dtype``, from its own camera with the moves replayed."""
        device = self.ctx.device
        camera = common.reference_camera(self.ctx.config, device, dtype)
        for key in self.applied:
            camera = common.moved_camera(camera, key, self.ctx.traffic["time_step"])
        return common.sample_sums(self.arrays, self.lights, self.ctx.config, self.render_seed,
                                  self.out["samples"], self.out["pixels"],
                                  self.ctx.traffic["check_batch"], camera, dtype, device)

    def check(self, frame=None, count=None) -> list:
        """The checks of the window's output (or of ``frame`` and ``count``
        put in its place)."""
        if not hasattr(self, "_ref"):
            self._ref = self.reference()
        own = frame is None
        return common.pixel_checks(
            self.ctx.traffic["limits"], self.out["frame"] if own else frame,
            self.out["count"] if own else count, self.out["image"] if own else None,
            *self._ref)


def control(cell: Cell) -> list:
    """The checks with the reference in bfloat16 put in the program's
    place: the lower-precision control, which has to fail them."""
    frame, count = cell.reference(torch.bfloat16)
    return cell.check(frame.float(), count)

