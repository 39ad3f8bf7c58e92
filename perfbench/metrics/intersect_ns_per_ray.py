"""Device time of the intersector kernels (the walks of csrc/ and the
first-block keys, by kernel name) over the traced window's rays
(pixel-samples x bounces x 2), in ns a ray."""

NAMES = ("_intersect_kernel", "flat_kernel", "first_block_keys_kernel")


def read(summary):
    seconds = summary.seconds_of(*NAMES)
    if seconds <= 0 or summary.rays <= 0:
        return None
    return seconds * 1e9 / summary.rays
