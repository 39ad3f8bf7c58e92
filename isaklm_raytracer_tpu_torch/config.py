"""Runtime render configuration.

The reference pins all knobs at compile time in macros.h:3-17 (1920x1080,
3x3 px cells, KD depth 19, 100..5000 spp, 5% tolerance). Here they are a
runtime dataclass, copied field for field from the JAX package's
``config.py`` so that both packages read the same knobs.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All global rendering knobs (reference: macros.h).

    Attributes:
      width/height: output resolution (macros.h:3-4; reference 1920x1080).
      min_samples: adaptive-sampling floor (macros.h:13, MIN_SAMPLES=100).
      max_samples: progressive cap (macros.h:15, MAX_SAMPLES=5000).
      max_tolerance: adaptive stop: 95% CI half-width <= tolerance * mean
        luminance (macros.h:17, path_tracing.cuh:352-376).
      kd_tree_depth: max KD recursion depth (macros.h:11, KD_TREE_DEPTH=19).
      kd_leaf_size: leaf triangle cap (create_kd_tree.cuh:222,
        min_triangle_count=7).
      max_bounces: static wavefront loop bound. The reference loop is
        unbounded with Russian-roulette termination (path_tracing.cuh:279-319);
        a static cap keeps XLA shapes static. RR reweighting keeps the
        estimator unbiased as long as RR kills paths before the cap, which it
        does overwhelmingly for any physical throughput.
      rr_start_bounce: first bounce at which Russian roulette applies
        (the reference applies it every bounce, path_tracing.cuh:309-318).
      t_epsilon: minimum ray-hit distance (trace_ray.cuh:92, 1e-5).
    """

    width: int = 1920
    height: int = 1080
    min_samples: int = 100
    max_samples: int = 5000
    max_tolerance: float = 0.05
    kd_tree_depth: int = 19
    kd_leaf_size: int = 7
    max_bounces: int = 24
    rr_start_bounce: int = 0
    t_epsilon: float = 1e-5
    # Wavefront rays per inner pass: the image is processed in fixed-size
    # ray chunks by a Python loop, which bounds the working set of every
    # pass independently of resolution. 0 disables chunking.
    ray_chunk: int = 16384
    # Smallest compacted adaptive wavefront (integrator.render.compact_bucket):
    # the launch shrinks down this far as pixels converge. Lower = closer to
    # the reference's per-thread skip ideal (path_tracing.cuh:347-379); the
    # bucket ladder {num_pixels, /2, ..., min_wavefront} keeps the set of
    # wavefront sizes small.
    min_wavefront: int = 4096
    # Carry the lobe-selection probability's derivative on the lobe weights
    # (detached-ratio estimator, integrator/bsdf.py). Forward values are
    # identical either way; the flag matters once gradients are ported.
    lobe_ratio_grad: bool = True

    def __post_init__(self) -> None:
        if self.width <= 0 or self.height <= 0:
            raise ValueError("resolution must be positive")
        if self.max_bounces <= 0:
            raise ValueError("max_bounces must be positive")
        # Bounce streams live below the camera stream in the counter-mode
        # sampler (math/rng.py); overlapping them would silently correlate
        # camera jitter with deep-bounce variates.
        if self.max_bounces >= 255:
            raise ValueError("max_bounces must be < 255 (CAMERA_STREAM)")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


PI = math.pi
TAU = 2.0 * math.pi
HALF_PI = 0.5 * math.pi
