"""Offline renders to the converged image, as users of the CLI run them.

Images run back to back, each from a fresh G-buffer and a render seed of
its own drawn from ``--seed``, through ``integrator.render.render`` with
the adaptive gate on, in calls of ``block`` samples that carry the
G-buffer and the sample offset, until no pixel needs a sample or every
pixel has ``max_samples``; then the image is resolved
(``resolve_image``). The window ends between calls; its units are the
calls. Set-up runs every step shape an image meets (``_warm_up``). The pixel-samples the
G-buffers counted give ``rays_per_s.adaptive``: a metric apart from the
other cells' ``rays_per_s``, as a loop that reads the card once a step
spreads with the host.

The check: the image the window ended in, at the sample it reached (an
image of the demo outlasts a window), in it ``check_pixels`` pixels
drawn from the seed and the ``check_longest`` that took the most samples;
the reference runs each pixel's adaptive loop from its first sample:
the gate, every path, the sums. Counts, sums and resolved colours are
held against the program's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.core import Check, Window
from perfbench.drivers import common
from perfbench.reference import plain


class Cell:
    def __init__(self, ctx) -> None:
        self.ctx, t = ctx, ctx.traffic
        self.arrays = common.scene_arrays(ctx.config)
        self.scene = common.program_scene(self.arrays, ctx.device)
        self.config = common.render_config(ctx.config)
        self.camera = common.program_camera(ctx.config, ctx.device)
        self.lights = common.light_order(self.arrays, self.scene)
        self.started = 0
        self._warm_up()
        common.sync(ctx.device)

    def _warm_up(self) -> None:
        """Every step shape an image meets, run eagerly, captured and
        replayed: the full step from a fresh G-buffer, then each bucket of
        the compaction ladder from a G-buffer in which that many pixels
        still need samples (the others have ``max_samples``)."""
        from isaklm_raytracer_tpu_torch.integrator.render import render
        from isaklm_raytracer_tpu_torch.scene.types import GBuffer

        n = self.config.num_pixels
        floor = min(self.config.min_wavefront, n)
        ladder = [n]
        while -(-ladder[-1] // 2) >= floor:
            ladder.append(-(-ladder[-1] // 2))
        seed = common.word(self.ctx.seed, 10)
        for size in ladder:
            gb = GBuffer.create(n, self.ctx.device)
            if size < n:
                gb.count.fill_(self.config.max_samples)
                gb.count[:size] = 0
            render(self.scene, self.camera, self.config, 3, seed=seed, adaptive=True,
                   gbuffer=gb)

    def _block(self, gb, seed: int, offset: int):
        from isaklm_raytracer_tpu_torch.integrator.render import render

        block = self.ctx.traffic["block"]
        gb = render(self.scene, self.camera, self.config, block, seed=seed, adaptive=True,
                    gbuffer=gb, sample_offset=offset)
        return gb, offset + block

    def _done(self, gb, offset: int) -> bool:
        from isaklm_raytracer_tpu_torch.integrator.render import make_active_count_fn

        return offset >= self.config.max_samples or \
            int(make_active_count_fn(self.config)(gb)) == 0

    def window(self, seconds: float, t0: float) -> Window:
        from isaklm_raytracer_tpu_torch.integrator.render import resolve_image
        from isaklm_raytracer_tpu_torch.scene.types import GBuffer

        self.last = None
        samples = steps = blocks = 0
        gb = None
        setup_s = time.perf_counter() - t0
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            if gb is None:
                seed = common.word(self.ctx.seed, 20, self.started)
                gb, offset = GBuffer.create(self.config.num_pixels, self.ctx.device), 0
                self.started += 1
            before = gb.count
            gb, offset = self._block(gb, seed, offset)
            took = gb.count - before
            samples += int(took.sum(dtype=torch.int64))
            steps += int(took.max())
            blocks += 1
            self.last = {"seed": seed, "samples": offset, "gbuffer": gb}
            if self._done(gb, offset):
                self.last["image"] = resolve_image(gb, self.config).reshape(-1, 3)
                gb = None
        common.sync(self.ctx.device)
        elapsed = time.perf_counter() - start
        rays = samples * self.config.max_bounces * 2
        return Window(elapsed, blocks,
                      {"setup_s": setup_s, "rays_per_s.adaptive": rays / elapsed},
                      steps=steps, rays=float(rays))

    def release(self) -> None:
        """Keep the checked pixels of the image the window ended in; drop
        the rest."""
        from isaklm_raytracer_tpu_torch.integrator.render import resolve_image

        t = self.ctx.traffic
        self.out = []
        if self.last is not None:
            img, gb = self.last, self.last["gbuffer"]
            drawn = common.draw_pixels(self.ctx.seed, self.config.num_pixels,
                                       t["check_pixels"], 100)
            counts = gb.count.cpu().numpy()
            longest = np.argsort(-counts, kind="stable")[:t["check_longest"]]
            pixels = np.union1d(drawn, longest)
            ids = torch.as_tensor(pixels, device=self.ctx.device)
            # the image the window ended in, resolved as far as it got
            image = img.get("image")
            if image is None:
                image = resolve_image(gb, self.config).reshape(-1, 3)
            self.out.append({"seed": img["seed"], "samples": img["samples"], "pixels": pixels,
                             "frame": gb.frame[ids].cpu(), "sq": gb.sq_luminance[ids].cpu(),
                             "count": gb.count[ids].cpu(), "image": image[ids].cpu()})
        del self.last, self.scene

    def checked_units(self) -> int:
        return len(self.out)

    def reference(self, image: dict, dtype=torch.float32):
        """(frame, count) of one image's checked pixels: each pixel's
        adaptive loop run by the reference in ``dtype``."""
        t, device = self.ctx.traffic, self.ctx.device
        c = self.ctx.config
        scene, trace = common.reference_scene(self.arrays, self.lights, device, dtype)
        camera = common.reference_camera(c, device, dtype)
        sets = common.settings(c)
        pixels = torch.as_tensor(image["pixels"], device=device)
        n = pixels.shape[0]
        frame = torch.zeros((n, 3), dtype=dtype, device=device)
        sq = torch.zeros((n,), dtype=dtype, device=device)
        count = torch.zeros((n,), dtype=torch.int32, device=device)
        alive = torch.ones((n,), dtype=torch.bool, device=device)
        s = 0
        while s < image["samples"] and bool(alive.any()):
            span = range(s, min(s + t["check_block"], image["samples"]))
            rows = torch.nonzero(alive).squeeze(1)
            keys = common.sample_keys(image["seed"], span, device)
            rad = common.path_radiance(scene, trace, camera, sets,
                                       keys.repeat_interleave(rows.shape[0], dim=0),
                                       pixels[rows].repeat(len(span)), t["check_batch"])
            rad = rad.reshape(len(span), rows.shape[0], 3)
            f, q, k, on = frame[rows], sq[rows], count[rows], alive[rows]
            for j in range(len(span)):
                gate = on & plain.needs_sample(f, q, k, c["min_samples"], c["max_samples"],
                                               c["max_tolerance"])
                r = torch.where(gate[:, None], rad[j], 0.0)
                f = f + r
                q = q + torch.where(gate, torch.square(plain.luminance(r)), 0.0)
                k = k + gate.to(torch.int32)
                on = gate
            frame[rows], sq[rows], count[rows], alive[rows] = f, q, k, on
            s = span.stop
        return frame, count

    def check(self, outputs=None) -> list:
        """The checks of the window's images (or of ``outputs``, one
        (frame, count) an image, put in their place)."""
        if not self.out:
            return [Check("images_checked", 0.0, -1.0)]
        if not hasattr(self, "_ref"):
            self._ref = [self.reference(img) for img in self.out]
        own = outputs is None
        got = [(o["frame"], o["count"]) for o in self.out] if own else outputs

        def cat(xs):
            return torch.cat([x.cpu() for x in xs])

        return common.pixel_checks(
            self.ctx.traffic["limits"], cat(f for f, _ in got), cat(k for _, k in got),
            cat(o["image"] for o in self.out) if own else None,
            cat(f for f, _ in self._ref), cat(k for _, k in self._ref))


def control(cell: Cell) -> list:
    """The checks with the reference in bfloat16 put in the program's
    place."""
    return cell.check([tuple(x.float() if x.is_floating_point() else x
                             for x in cell.reference(img, torch.bfloat16))
                       for img in cell.out])
