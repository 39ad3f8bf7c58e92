"""Device time of the NCCL kernels of ``unshard_gbuffer``'s gathers of
the G-buffer (by kernel name: AllGather, or the Broadcasts of a gather
that NCCL splits) per image in rank 0's traced window, in ms. The
all_reduces of the active counts, which wait for the slowest tile, are
not counted."""

NAMES = ("AllGather", "Broadcast")


def read(summary):
    seconds = summary.seconds_of(*NAMES)
    if seconds <= 0 or summary.units <= 0:
        return None
    return seconds * 1e3 / summary.units
