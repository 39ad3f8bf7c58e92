"""The device's idle share of a traced offline render window (the adaptive
loop, a host sync a step): its span less the union of its records'
intervals, in percent. It moves ``rays_per_s.adaptive``."""


def read(summary):
    if summary.kind != "render" or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
