from isaklm_raytracer_tpu_torch.kernels.intersect import (
    COUNTS,
    FLAT_CLUSTER_LIMIT,
    flat_intersect,
    flat_intersect_plain,
    nearest_hit_flat,
)

__all__ = [
    "COUNTS",
    "FLAT_CLUSTER_LIMIT",
    "flat_intersect",
    "flat_intersect_plain",
    "nearest_hit_flat",
]
