"""Device time of the shading kernels (shade_bounce, finish_bounce) and
the sampler (threefry_uniforms) over a traced offline render window's
rays (pixel-samples x bounces x 2), in ns a ray. It moves
``rays_per_s.adaptive``."""

NAMES = ("shade_bounce_kernel", "finish_bounce_kernel", "threefry_uniforms_kernel")


def read(summary):
    seconds = summary.seconds_of(*NAMES)
    if seconds <= 0 or summary.rays <= 0:
        return None
    return seconds * 1e9 / summary.rays
