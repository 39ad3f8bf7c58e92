"""The device's idle share of a traced render window: its span less the
union of its records' intervals, in percent."""


def read(summary):
    if summary.kind != "render" or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
