from isaklm_raytracer_tpu_torch.math import color, rng, sampling, transforms

__all__ = ["color", "rng", "sampling", "transforms"]
