"""Device time of the backward kernels (bounce_bin, bounce_backward) per
train step of the traced window, in ms."""

NAMES = ("bounce_bin_kernel", "bounce_backward_kernel")


def read(summary):
    seconds = summary.seconds_of(*NAMES)
    if seconds <= 0 or summary.steps <= 0:
        return None
    return seconds * 1e3 / summary.steps
