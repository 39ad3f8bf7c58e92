"""Device time of the intersector kernels (by kernel name) over a traced
offline render window's rays (pixel-samples x bounces x 2), in ns a ray.
It moves ``rays_per_s.adaptive``."""

NAMES = ("_intersect_kernel", "flat_kernel", "first_block_keys_kernel")


def read(summary):
    seconds = summary.seconds_of(*NAMES)
    if seconds <= 0 or summary.rays <= 0:
        return None
    return seconds * 1e9 / summary.rays
