"""The share of the lanes the adaptive loop launched that took a sample, in
percent, over a traced offline render window: 100 x the sum of ``active``
over the sum of ``lanes`` of the program's ``render.step`` and
``render.tail`` spans (``isaklm_raytracer_tpu_torch.telemetry``) that
overlap the window (first record's start to last record's end). A full
step launches every pixel, a tail step its bucket; the loop counts the
active ones at its one read a step. None where the window holds no such
span (a program without spans). It moves ``rays_per_s.adaptive``."""

STEPS = ("render.step", "render.tail")


def read(summary):
    if summary.kind != "render" or not summary.records:
        return None
    try:
        from isaklm_raytracer_tpu_torch import telemetry
    except ImportError:
        return None
    lo = summary.records[0][1]
    hi = max(s + d for _, s, d in summary.records)
    lanes = active = 0
    for s in telemetry.spans():
        if s.name in STEPS and s.end_ns is not None and s.start_ns < hi and s.end_ns > lo:
            lanes += s.counts["lanes"]
            active += s.counts["active"]
    return 100.0 * active / lanes if lanes else None
