"""Interactive progressive-rendering session (headless).

Port of ``isaklm_raytracer_tpu/viewer.py``: the reference's GLFW window
loop (main.cu:114-155 + camera_movement, camera.cuh:28-100) as a stateful
session that adds one sample per step, restarts accumulation on any camera
input, and exposes the tonemapped running average at every moment. The
display (``cli.preview``'s terminal preview, or any other) wraps it.

Step i of an accumulation uses the key words of sample i of ``seed``
(``rng.sample_key_words``, the JAX package's ``fold_in(PRNGKey(seed), i)``),
so a session's image equals ``integrator.render.render`` of as many samples
from the same camera.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.camera.camera import Camera, camera_movement
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.render import make_step_fn, resolve_image
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.types import GBuffer, Scene


class InteractiveSession:
    """Progressive render session with reference input semantics, on the
    scene's device."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        config: RenderConfig,
        seed: int = 0,
        adaptive: bool = True,
    ) -> None:
        self.scene = scene
        self.camera = camera
        self.config = config
        self.adaptive = adaptive
        self.seed = seed
        self._sample = 0
        self._last_time: Optional[float] = None
        self.gbuffer = GBuffer.create(config.num_pixels, scene.device)
        self._step = make_step_fn(config)

    @property
    def sample_count(self) -> int:
        """Progressive frame counter (main.cu:124: sample_count)."""
        return self._sample

    def handle_input(self, keys: Iterable[str], time_step: Optional[float] = None):
        """Apply movement keys; any input resets accumulation
        (camera.cuh:38-98 zero sample_count)."""
        now = time.monotonic()
        if time_step is None:
            time_step = 0.0 if self._last_time is None else now - self._last_time
        self._last_time = now
        self.camera, moved = camera_movement(self.camera, keys, time_step)
        if moved:
            self.reset()
        return moved

    def reset(self) -> None:
        """Zero the accumulators (reset_frame, render.cuh:18-34)."""
        self.gbuffer = GBuffer.create(self.config.num_pixels, self.scene.device)
        self._sample = 0

    @torch.no_grad()
    def step(self, keys: Iterable[str] = ()) -> None:
        """One frame: input -> render one progressive sample
        (call_render, main.cu:20-59) through ``make_step_fn``, as the JAX
        session jits its step: on the card a CUDA graph replays it, with
        the moved camera copied into the graph's inputs."""
        if keys:
            self.handle_input(keys)
        key_words = rng.sample_key_words(self.seed, self._sample)
        self.gbuffer = self._step(
            self.scene, self.camera, self.gbuffer, key_words, self.adaptive
        )
        self._sample += 1

    def image(self) -> np.ndarray:
        """Current tonemapped average, (H, W, 3) float in [0,1]
        (draw_frame, render.cuh:37-59)."""
        return resolve_image(self.gbuffer, self.config).cpu().numpy()

    def converged(self) -> bool:
        if int(self.gbuffer.count.min()) < self.config.min_samples:
            return False
        return not bool(needs_sample(self.gbuffer, self.config).any())

    def run(self, max_samples: Optional[int] = None, save_path: Optional[str] = None):
        """Headless main loop: render until MAX_SAMPLES or convergence, then
        optionally save the PNG (main.cu:114-132)."""
        limit = max_samples or self.config.max_samples
        while self._sample < limit and not (self.adaptive and self.converged()):
            self.step()
        if save_path:
            from isaklm_raytracer_tpu_torch.io.png import save_png

            save_png(save_path, self.image())
        return self.image()
